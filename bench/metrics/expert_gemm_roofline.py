"""The grouped expert product's share of its roofline: the operations of
its launches over their device time at the card's dense bf16 peak
(989.4e12, H100 SXM). From the traced window: the device time of its
``grouped_gemm_kernel`` intervals, and the operations from the kernel's
counter (``kernels.grouped_gemm.ops.flops()``, 2 x rows x K x N a launch,
summed on the card since the process started) scaled by the window's steps
over all the steps the run took (the warm steps too). Nothing without a
trace, without a launch, or where the trace's costliest operations leave the
kernel out."""
from bench.harness.driver import WARM_STEPS

PEAK_FLOPS = 989.4e12
KERNEL = "grouped_gemm_kernel"


def read(r):
    t = r.trace
    if not t or not r.step_ends:
        return None
    try:
        from repro_torch.kernels.grouped_gemm import ops
    except ImportError:
        return None
    if not ops.grouped_gemm.launches:
        return None
    device_s = sum(s for name, s in t.get("device_ops", ()) if KERNEL in name)
    if device_s <= 0:
        return None
    steps = len(r.step_ends)
    flops = ops.flops() * steps / (steps + WARM_STEPS)
    return 100.0 * flops / (device_s * PEAK_FLOPS)
