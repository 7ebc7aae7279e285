"""Discrete-event machinery of the fleet simulator (DESIGN.md §7): the
(time, seq)-ordered :class:`EventQueue`, the canonical :class:`EventLog`
with its replay digest and the stateless :class:`HashRng` the change feed
and the pooler draw from. The fleet harness, traffic models, chaos
schedules and invariant checkers are not ported yet."""
from repro_torch.sim.events import Event, EventLog, EventQueue, HashRng

__all__ = ["Event", "EventLog", "EventQueue", "HashRng"]
