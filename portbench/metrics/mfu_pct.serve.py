"""Model FLOPs of the window's prefills and decode steps (2 x matmul
parameters a token, attention over each request's own tokens, padding not
counted) over the window's time, as a share of the card's dense bf16
peak."""

from portbench import yardstick


def read(cell):
    sv = cell.layer.get("serve")
    if not sv:
        return None
    return 100.0 * sv["model_flops"] / sv["window_s"] / yardstick.PEAK_FLOPS_BF16
