"""The window's model FLOPs over what the card's dense bf16 peak could do
in its seconds: FLOPs an example (counted from the plain reference's
forward and backward pass, ``reference.flops``) times the examples trained,
over the window's seconds times 989.4e12 (H100 SXM, NVIDIA's data sheet)."""

PEAK_FLOPS = 989.4e12


def read(r):
    if not r.flops_per_example or not r.examples:
        return None
    return (100.0 * r.flops_per_example * r.examples
            / (r.window_s * PEAK_FLOPS))
