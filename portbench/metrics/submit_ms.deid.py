"""Mean wall milliseconds of ``DeidService.submit_query`` (catalog select
on the card, planner, publish) over the window's calls, timed by the
benchmark around each call."""


def read(cell):
    calls = cell.layer.get("deid", {}).get("submit_s", [])
    return 1e3 * sum(calls) / len(calls) if calls else None
