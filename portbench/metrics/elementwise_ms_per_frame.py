"""elementwise_ms_per_frame (device trace): device milliseconds a frame of
PyTorch's elementwise kernels (at::native ... elementwise_kernel: the
exact float layer, the int64 PCG emulation, selects), by kernel name,
gathers excluded."""

from portbench.kernel_names import is_elementwise


def read(run):
    prof = run.get("prof")
    if prof is None:
        return None
    s = sum(sec for name, (sec, _) in prof["by_name"].items()
            if is_elementwise(name))
    return 1e3 * s / run["requests"] if s > 0 else None
