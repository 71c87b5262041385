"""PECOS on PyTorch + CUDA: XR-Linear training and prediction, and ANN search, for one NVIDIA GPU.

The port of ``pecos_tpu`` (JAX on TPU) to PyTorch, with every Pallas kernel
replaced by a CUDA kernel written by hand for Hopper (``sm_90a``).  Module
paths mirror ``pecos_tpu`` so each function's counterpart is found at the same
place:

- ``pecos_tpu_torch.xmc``   — XR-Linear models, their Newton-CG training
  (``xmc/solvers.py``), balanced clustering (``xmc/clustering.py``) and the
  beam-search predict engine (``xmc/inference.py``).
- ``pecos_tpu_torch.ann``   — HNSW build and search over dense or sparse
  features (``ann/hnsw/graph.py``), PQ4 (``ann/hnsw/pq.py``) and PairwiseANN.
- ``pecos_tpu_torch.ops``   — the hand-written kernels, their plain PyTorch
  versions and the build that compiles them at first use.
- ``pecos_tpu_torch.utils`` — host helpers (sparse-matrix I/O, metrics, cluster
  tables, device selection).

The port imports torch, numpy and scipy, never jax, and nothing of
``pecos_tpu`` (that package imports jax when it is imported).

Config system: every model class derives from :class:`BaseClass` whose nested
``PredParams`` dataclasses derive from :class:`BaseParams`.  Params round-trip
through JSON with an embedded ``__meta__.class_fullname``, in the same format
``pecos_tpu`` writes, so model folders and params files move between the two
packages.
"""

from __future__ import annotations

import copy
import dataclasses as dc
import importlib
import json
from typing import Any, Dict, Optional, Type

__version__ = "0.1.0"


class _ClassRegistry(type):
    """Metaclass registering every BaseClass/BaseParams subclass by full name,
    so ``__meta__.class_fullname`` strings in saved params resolve to classes."""

    _registry: Dict[str, type] = {}

    def __new__(mcs, name, bases, namespace):
        cls = super().__new__(mcs, name, bases, namespace)
        _ClassRegistry._registry[class_fullname(cls)] = cls
        return cls

    @staticmethod
    def lookup(fullname: str) -> type:
        """The class a ``__meta__.class_fullname`` names.  A name written by the
        JAX package (``pecos_tpu.<module>###<qualname>``) resolves to the
        port's class of the same qualname in ``pecos_tpu_torch.<module>``;
        ``pecos_tpu`` itself is never imported.  Raises ValueError for a name
        with no class behind it."""
        module, sep, qualname = fullname.partition("###")
        if module == "pecos_tpu" or module.startswith("pecos_tpu."):
            module = "pecos_tpu_torch" + module[len("pecos_tpu"):]
        name = f"{module}{sep}{qualname}"
        if name not in _ClassRegistry._registry and module.split(".", 1)[0] == "pecos_tpu_torch":
            try:  # import the defining module, which registers its classes
                importlib.import_module(module)
            except ModuleNotFoundError as e:
                if not (e.name and module.startswith(e.name)):
                    raise  # a module the port's module imports is missing
                raise ValueError(f"params class {fullname!r}: no module {module!r} in the port") from e
        if name not in _ClassRegistry._registry:
            raise ValueError(f"params class {fullname!r} has no counterpart in pecos_tpu_torch")
        return _ClassRegistry._registry[name]


def class_fullname(cls: type) -> str:
    return f"{cls.__module__}###{cls.__qualname__}"


class BaseParams(metaclass=_ClassRegistry):
    """Base for all (dataclass) parameter containers: recursive
    ``from_dict``/``to_dict`` with polymorphic ``__meta__`` blocks."""

    @classmethod
    def from_dict(cls, param: Optional[Dict[str, Any]] = None, recursive: bool = True):
        if param is None:
            return cls()
        if isinstance(param, cls):
            return copy.deepcopy(param)
        if not isinstance(param, dict):
            raise ValueError(f"expect param to be {cls} or dict, got {type(param)}")
        meta = param.get("__meta__", None)
        target_cls: Type[BaseParams] = cls
        if meta and "class_fullname" in meta:
            target_cls = _ClassRegistry.lookup(meta["class_fullname"])  # type: ignore[assignment]
            if not issubclass(target_cls, cls):
                raise ValueError(
                    f"params __meta__ says {target_cls}, which is not a subclass of {cls}"
                )
        field_names = {f.name for f in dc.fields(target_cls)}  # type: ignore[arg-type]
        kwargs: Dict[str, Any] = {}
        for key, val in param.items():
            if key == "__meta__":
                continue
            if key not in field_names:
                raise ValueError(f"unknown param field {key!r} for {target_cls}")
            kwargs[key] = val
        obj = target_cls(**kwargs)
        if recursive:
            for f in dc.fields(obj):  # type: ignore[arg-type]
                v = getattr(obj, f.name)
                if isinstance(v, dict) and "__meta__" in v:
                    sub_cls = _ClassRegistry.lookup(v["__meta__"]["class_fullname"])
                    setattr(obj, f.name, sub_cls.from_dict(v))
        return obj

    def to_dict(self, with_meta: bool = True) -> Dict[str, Any]:
        d: Dict[str, Any] = {}
        for f in dc.fields(self):  # type: ignore[arg-type]
            v = getattr(self, f.name)
            if isinstance(v, BaseParams):
                d[f.name] = v.to_dict(with_meta=with_meta)
            elif isinstance(v, (list, tuple)):
                d[f.name] = [
                    x.to_dict(with_meta=with_meta) if isinstance(x, BaseParams) else x
                    for x in v
                ]
            else:
                d[f.name] = copy.deepcopy(v)
        if with_meta:
            d["__meta__"] = {"class_fullname": class_fullname(type(self))}
        return d

    def to_json(self, with_meta: bool = True, indent: int = 2) -> str:
        return json.dumps(self.to_dict(with_meta=with_meta), indent=indent)

    @classmethod
    def from_json(cls, s: str):
        return cls.from_dict(json.loads(s))

    def override_with_kwargs(self, pred_kwargs: Optional[Dict[str, Any]]):
        """In-place override of fields from a plain kwargs dict (ignores None)."""
        if pred_kwargs is not None:
            if not isinstance(pred_kwargs, dict):
                raise ValueError("pred_kwargs should be a dict")
            names = {f.name for f in dc.fields(self)}  # type: ignore[arg-type]
            for k, v in pred_kwargs.items():
                if k in names and v is not None:
                    setattr(self, k, v)
        return self


class BaseClass(metaclass=_ClassRegistry):
    """Base for all model classes; pairs with nested PredParams."""

    @classmethod
    def append_meta(cls, d: Dict[str, Any]) -> Dict[str, Any]:
        d = dict(d)
        d["__meta__"] = {"class_fullname": class_fullname(cls)}
        return d
