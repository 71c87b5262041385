"""Memory reporting for phase-boundary logs (the port of ``pecos_tpu/utils/profile_util.py``)."""

from __future__ import annotations

import os


class MemInfo(object):
    @staticmethod
    def mem_info() -> str:
        """The process's resident set size, as ``mem: rss=<GB>GB``."""
        try:
            import psutil

            rss = psutil.Process(os.getpid()).memory_info().rss
        except ImportError:
            try:
                with open("/proc/self/statm") as f:
                    rss = int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")
            except OSError:
                return "mem_info unavailable"
        return f"mem: rss={rss / 2**30:.2f}GB"

    @staticmethod
    def device_mem_info() -> str:
        """Memory in use and total of each CUDA device, or ``no device stats``."""
        import torch

        if not torch.cuda.is_available():
            return "no device stats"
        parts = []
        for i in range(torch.cuda.device_count()):
            free, total = torch.cuda.mem_get_info(i)
            parts.append(f"cuda:{i}: {(total - free) / 2**30:.2f}/{total / 2**30:.2f}GB")
        return "; ".join(parts)
