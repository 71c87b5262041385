"""Host-level control-plane communication (DistComm-shaped).

The port of ``pecos_tpu/parallel/comm.py``.  Distributed training moves small
host objects between processes: cluster chains, label subsets, trained
sub-models.  This layer carries them as pickles; the device data plane is not
its concern.

- ``DummyComm``: one rank in one process.
- ``FakeClusterComm`` / ``FakeRankComm``: N ranks as threads of one process,
  collectives meeting at a barrier (tests, and a single host driving one card).
- ``MultihostComm``: one rank per process over ``torch.distributed``: the
  collectives are the object collectives of the default process group, and
  point-to-point messages are length-prefixed uint8 tensors over gloo.
"""

from __future__ import annotations

import abc
import pickle
import queue
import threading
from typing import Any, List, Optional

import numpy as np
import torch


class DistComm(abc.ABC):
    """Abstract send/recv/bcast/scatter/gather of picklable host objects."""

    @abc.abstractmethod
    def get_size(self) -> int: ...

    @abc.abstractmethod
    def get_rank(self) -> int: ...

    @abc.abstractmethod
    def send(self, obj: Any, dest: int, tag: int = 0) -> None: ...

    @abc.abstractmethod
    def recv(self, source: int, tag: int = 0) -> Any: ...

    @abc.abstractmethod
    def bcast(self, obj: Any, root: int = 0) -> Any: ...

    @abc.abstractmethod
    def scatter(self, objs: Optional[List[Any]], root: int = 0) -> Any: ...

    @abc.abstractmethod
    def gather(self, obj: Any, root: int = 0) -> Optional[List[Any]]: ...


class DummyComm(DistComm):
    """In-process fake with a single rank; send/recv pairs go through a queue."""

    def __init__(self):
        self._mailbox = {}

    def get_size(self) -> int:
        return 1

    def get_rank(self) -> int:
        return 0

    def send(self, obj, dest: int, tag: int = 0) -> None:
        if dest != 0:
            raise ValueError("DummyComm only has rank 0")
        self._mailbox.setdefault(tag, []).append(obj)

    def recv(self, source: int, tag: int = 0):
        if source != 0:
            raise ValueError("DummyComm only has rank 0")
        box = self._mailbox.get(tag, [])
        if not box:
            raise RuntimeError(f"DummyComm.recv: no message with tag {tag}")
        return box.pop(0)

    def bcast(self, obj, root: int = 0):
        return obj

    def scatter(self, objs, root: int = 0):
        if objs is None or len(objs) != 1:
            raise ValueError("DummyComm.scatter expects a list of length 1")
        return objs[0]

    def gather(self, obj, root: int = 0):
        return [obj]


class MultihostComm(DistComm):
    """One rank per process over an initialised ``torch.distributed`` group.

    ``bcast``, ``scatter`` and ``gather`` are ``broadcast_object_list``,
    ``scatter_object_list`` and ``gather_object`` on the default group.
    ``send``/``recv`` carry a pickle as a uint8 tensor after an int64 header
    (sequence number, length) by ``dist.isend``/``dist.recv`` with the tag, on
    the default group when its backend is gloo and otherwise on a gloo group
    made here (NCCL sends only CUDA tensors and ignores tags).  ``send``
    returns at once, as the other comms' sends do: it keeps each message's
    tensors until gloo has sent them, so a rank may send on one tag while its
    peer first reads another.  Each (peer, tag) pair numbers its messages, and
    ``recv`` raises if the header it reads is not the next one, so mismatched
    send/recv pairs fail loudly.

    Construct it on every rank at the same point of the program: making the
    gloo group is itself a collective.
    """

    def __init__(self):
        import torch.distributed as dist

        if not (dist.is_available() and dist.is_initialized()):
            raise RuntimeError(
                "MultihostComm needs a torch.distributed process group: call "
                "torch.distributed.init_process_group(...) first (torchrun sets up its environment)"
            )
        self._dist = dist
        self._rank = dist.get_rank()
        self._size = dist.get_world_size()
        self._p2p_group = None if dist.get_backend() == "gloo" else dist.new_group(backend="gloo")
        self._send_seq: dict = {}
        self._recv_seq: dict = {}
        self._in_flight: list = []  # (isend work, its tensor) until the work completes

    def get_size(self) -> int:
        return self._size

    def get_rank(self) -> int:
        return self._rank

    def bcast(self, obj, root: int = 0):
        box = [obj if self._rank == root else None]
        self._dist.broadcast_object_list(box, src=root)
        return box[0]

    def scatter(self, objs, root: int = 0):
        if self._rank == root and (objs is None or len(objs) != self._size):
            raise ValueError(f"scatter needs a list of length {self._size} on root")
        out = [None]
        self._dist.scatter_object_list(out, objs if self._rank == root else None, src=root)
        return out[0]

    def gather(self, obj, root: int = 0):
        out = [None] * self._size if self._rank == root else None
        self._dist.gather_object(obj, out, dst=root)
        return out

    @staticmethod
    def _next(seqs: dict, key) -> int:
        seq = seqs.get(key, 0)
        seqs[key] = seq + 1
        return seq

    def send(self, obj, dest: int, tag: int = 0) -> None:
        seq = self._next(self._send_seq, (dest, tag))
        payload = torch.from_numpy(np.frombuffer(pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL), np.uint8).copy())
        head = torch.tensor([seq, payload.numel()], dtype=torch.int64)
        self._in_flight = [(w, t) for w, t in self._in_flight if not w.is_completed()]
        for t in (head, payload):
            self._in_flight.append((self._dist.isend(t, dst=dest, group=self._p2p_group, tag=tag), t))

    def recv(self, source: int, tag: int = 0):
        seq = self._next(self._recv_seq, (source, tag))
        head = torch.empty(2, dtype=torch.int64)
        self._dist.recv(head, src=source, group=self._p2p_group, tag=tag)
        if int(head[0]) != seq:
            raise RuntimeError(f"recv from rank {source} tag {tag}: message {int(head[0])} arrived, expected {seq}")
        payload = torch.empty(int(head[1]), dtype=torch.uint8)
        self._dist.recv(payload, src=source, group=self._p2p_group, tag=tag)
        return pickle.loads(payload.numpy().tobytes())


class _FakeClusterState:
    """Shared state for FakeClusterComm ranks running as threads."""

    def __init__(self, size: int):
        self.size = size
        self.barrier = threading.Barrier(size)
        self.slot: List[Any] = [None] * size
        self.queues: dict = {}
        self.qlock = threading.Lock()

    def queue_for(self, src: int, dst: int, tag: int) -> "queue.Queue":
        with self.qlock:
            return self.queues.setdefault((src, dst, tag), queue.Queue())


class FakeClusterComm:
    """Factory for an in-process N-rank comm: each rank runs in its own
    thread, collectives synchronize on barriers (the N-rank generalization of
    the single-rank DummyComm)."""

    def __init__(self, size: int):
        self.state = _FakeClusterState(size)

    def rank_comm(self, rank: int) -> "FakeRankComm":
        return FakeRankComm(self.state, rank)


class FakeRankComm(DistComm):
    def __init__(self, state: _FakeClusterState, rank: int):
        self._state = state
        self._rank = rank

    def get_size(self) -> int:
        return self._state.size

    def get_rank(self) -> int:
        return self._rank

    def send(self, obj, dest: int, tag: int = 0) -> None:
        self._state.queue_for(self._rank, dest, tag).put(obj)

    def recv(self, source: int, tag: int = 0):
        return self._state.queue_for(source, self._rank, tag).get(timeout=600)

    def bcast(self, obj, root: int = 0):
        st = self._state
        if self._rank == root:
            st.slot[root] = obj
        st.barrier.wait()
        out = st.slot[root]
        st.barrier.wait()
        return out

    def scatter(self, objs, root: int = 0):
        st = self._state
        if self._rank == root:
            if objs is None or len(objs) != st.size:
                raise ValueError(f"scatter needs a list of length {st.size} on root")
            st.slot[root] = objs
        st.barrier.wait()
        out = st.slot[root][self._rank]
        st.barrier.wait()
        return out

    def gather(self, obj, root: int = 0):
        st = self._state
        st.slot[self._rank] = obj
        st.barrier.wait()
        out = list(st.slot) if self._rank == root else None
        st.barrier.wait()
        return out
