"""End-user applications built on the XMC stack."""
