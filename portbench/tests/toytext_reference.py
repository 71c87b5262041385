"""The toy text-in kind's plain reference, in float64 PyTorch: the texts'
mean embeddings worked out again from the benchmark's table, at unit L2
norm, appended to the TF-IDF rows, then ``xrlinear_reference``'s beam search
over the concatenation with the ranker's arrays (D + H columns)."""

from __future__ import annotations

from typing import Dict

import numpy as np
import scipy.sparse as smat
import torch

from portbench.models import xrlinear_reference


class Reference:
    def __init__(self, model, cfg: Dict, device: torch.device):
        self.ranker = xrlinear_reference.build(model, cfg, device)
        self.embed = model.embed.to(device=device, dtype=torch.float64)
        self.children, self.depth = self.ranker.children, self.ranker.depth

    def features(self, Q) -> smat.csr_matrix:
        """(n, D + H) float64: each TF-IDF row, then its text's embedding."""
        rows = []
        for r in range(Q.shape[0]):
            tok = torch.as_tensor(Q.tok_ids[Q.tok_ptr[r] : Q.tok_ptr[r + 1]].astype(np.int64), device=self.embed.device)
            mean = self.embed[tok].mean(0)
            rows.append((mean / torch.linalg.vector_norm(mean)).cpu().numpy())
        return smat.hstack([Q.X.astype(np.float64), smat.csr_matrix(np.stack(rows))], format="csr")

    def beam_search(self, Q, keep_beams: bool = False):
        return self.ranker.beam_search(self.features(Q), keep_beams=keep_beams)

    def path_values(self, Q, labels: np.ndarray) -> np.ndarray:
        return self.ranker.path_values(self.features(Q), labels)


def build(model, cfg: Dict, device: torch.device) -> Reference:
    return Reference(model, cfg, device)
