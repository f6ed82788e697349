"""Kernel-name classes of the device trace (PyTorch's and the port's
kernel names as the profiler reports them)."""

GATHER = ("gather", "index", "scatter")


def is_gather(name: str) -> bool:
    n = name.lower()
    return any(k in n for k in GATHER)


def is_elementwise(name: str) -> bool:
    return "elementwise_kernel" in name and not is_gather(name)
