"""cornus-opt1 (Table 3 row 3, 2.5 RTT): the Paxos leader forwards the vote.

The port's copy of ``repro/core/protocols/cornus_opt1.py`` (the standard
library only; the port imports nothing of the JAX package).

Identical to Cornus except the participant's LogOnce(VOTE-YES) asks the
storage service to forward the slot's decided value *directly* to the
coordinator — saving the leader→participant→coordinator dog-leg (half an
inter-replica RTT on the prepare path).  The participant still receives its
own reply (it needs to learn whether a termination peer won the CAS), but
the coordinator no longer waits for it.
"""
from __future__ import annotations

from .cornus import CornusProtocol
from .registry import register


@register("cornus-opt1")
class CornusOpt1Protocol(CornusProtocol):

    forwards_votes = True
    preferred_storage_mode = "leader"   # the row assumes a forwarding leader
