"""XMR: extreme multi-label ranking (the reranker)."""
