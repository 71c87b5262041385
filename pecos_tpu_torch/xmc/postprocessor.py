"""Beam-search score post-processors (counterpart of ``pecos_tpu/xmc/postprocessor.py``).

Names noop, sigmoid, log-sigmoid, l1..l4-hinge and log-l1..l4-hinge.  Each is
(transform, combiner, init) where ``init`` is the combiner's identity element
that seeds the root of the beam search (1.0 for multiplies, 0.0 for plus/noop).
Numpy callables serve host code; torch callables serve the device path.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, ClassVar, Dict, Optional

import numpy as np
import torch


def _int_pow(x: torch.Tensor, p: int) -> torch.Tensor:
    """x**p by the same square-and-multiply sequence as jax.lax.integer_pow,
    so the rounding matches JAX's ``x ** p`` step for step."""
    acc = None
    while p > 0:
        if p & 1:
            acc = x if acc is None else acc * x
        p >>= 1
        if p > 0:
            x = x * x
    return acc


@dataclasses.dataclass(frozen=True)
class PostProcessor:
    name: str
    transform_np: Callable
    combiner_np: Callable
    transform_torch: Callable
    combiner_torch: Callable
    init_value: float

    _registry: ClassVar[Optional[Dict[str, "PostProcessor"]]] = None

    @classmethod
    def _build(cls) -> Dict[str, "PostProcessor"]:
        reg: Dict[str, PostProcessor] = {}

        def add(name, t_np, c_np, t_t, c_t, init):
            reg[name] = cls(name, t_np, c_np, t_t, c_t, init)

        ident = lambda v: v
        noopc = lambda x, y: x
        plus = lambda x, y: x + y
        mult = lambda x, y: x * y

        add("noop", ident, noopc, ident, noopc, 0.0)
        add(
            "sigmoid",
            lambda v: 1.0 / (1.0 + np.exp(-v)),
            mult,
            lambda v: torch.reciprocal(1.0 + torch.exp(-v)),
            mult,
            1.0,
        )
        add(
            "log-sigmoid",
            lambda v: -np.log1p(np.exp(-v)),
            plus,
            lambda v: -torch.log1p(torch.exp(-v)),
            plus,
            0.0,
        )
        for p in range(1, 5):
            # log-lp-hinge(v) = -max(1 - v, 0)^p ; lp-hinge = exp(log-lp-hinge)
            def t_log_np(v, p=p):
                return -(np.maximum(1.0 - v, 0.0) ** p)

            def t_log_t(v, p=p):
                return -_int_pow(torch.clamp(1.0 - v, min=0.0), p)

            def t_np(v, p=p):
                return np.exp(-(np.maximum(1.0 - v, 0.0) ** p))

            def t_t(v, p=p):
                return torch.exp(-_int_pow(torch.clamp(1.0 - v, min=0.0), p))

            add(f"l{p}-hinge", t_np, mult, t_t, mult, 1.0)
            add(f"log-l{p}-hinge", t_log_np, plus, t_log_t, plus, 0.0)
        return reg

    @classmethod
    def get(cls, name) -> "PostProcessor":
        if isinstance(name, cls):
            return name
        if cls._registry is None:
            cls._registry = cls._build()
        if name is None or name is False:
            name = "noop"
        elif name is True:
            name = "l3-hinge"
        if name not in cls._registry:
            raise ValueError(f"unknown post_processor {name!r}; valid: {sorted(cls._registry)}")
        return cls._registry[name]

    @classmethod
    def valid_list(cls):
        if cls._registry is None:
            cls._registry = cls._build()
        return list(cls._registry.keys())
