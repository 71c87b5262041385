from .comm_check import run_comm_self_test, run_device_collective_probe  # noqa: F401
