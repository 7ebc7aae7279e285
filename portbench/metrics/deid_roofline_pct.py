"""The de-identification stage's share of its memory roofline: the least
device time for the work of the chunks completed in the traced window
(every source pixel read once, the compressed stream or the blanked pixels
written once, at the card's HBM rate), over the device time of all kernels
in that window. Counted from the chunks, not from which kernels ran."""

from portbench import yardstick


def read(cell):
    deid = cell.layer.get("deid")
    kernel_s = cell.layer.get("kernel_s", 0.0)
    if not deid or kernel_s <= 0:
        return None
    t0, t1 = cell.window
    chunks = [(px, pl) for t, px, pl in deid["chunk_times"] if t0 <= t <= t1]
    if not chunks:
        return None
    least = yardstick.deid_min_bytes(sum(px for px, _ in chunks), sum(pl for _, pl in chunks),
                                     deid["recompress"]) / yardstick.HBM_BYTES_PER_S
    return 100.0 * least / kernel_s
