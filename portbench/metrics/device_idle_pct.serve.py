"""Share of the traced window in which no kernel or copy ran on the card
(``torch.profiler``'s device activity, union of intervals)."""


def read(cell):
    window = cell.layer.get("window_s", 0.0)
    if window <= 0:
        return None
    return 100.0 * (1.0 - cell.layer["busy_s"] / window)
