"""Milliseconds a batch's prefill in the granite cell, on the benchmark's
clock: from the call into the model's prefill to the synchronize after it,
over the prefills the window ran."""


def read(cell):
    sv = cell.layer.get("serve")
    if not sv or not sv.get("prefills"):
        return None
    return 1e3 * sv["prefill_s"] / sv["prefills"]
