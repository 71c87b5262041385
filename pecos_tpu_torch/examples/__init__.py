"""Examples on the port: ``fm_for_xmc`` (factorization machines for XMC retrieval)."""
