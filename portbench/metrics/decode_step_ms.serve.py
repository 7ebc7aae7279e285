"""Milliseconds a decode step: the window's batch time less its prefill
time (both on the benchmark's clock, the prefill ending in a synchronize),
over the decode steps the window ran."""


def read(cell):
    sv = cell.layer.get("serve")
    if not sv or sv["decode_steps"] == 0:
        return None
    return 1e3 * (sum(sv["batch_s"]) - sv["prefill_s"]) / sv["decode_steps"]
