"""Milliseconds a GB of source pixels in ``planner.materialize``, opened by
``CohortPlanner._materialize``: every instance record of a finished study
read back out of the result lake and decoded for the cohort's ticket (in
``resolve``, which ``submit_cohort`` runs first); self time inside the
window."""
from portbench import spans


def read(cell):
    return spans.ms_per_gb(cell, ("planner.materialize",))
