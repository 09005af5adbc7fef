"""Bulk index construction: the host parts the fragment needs.

``build.plane_positions`` (overlay materialization) and ``lazy.LEDGER``
(the materialization-debt registry) are imported lazily by
``core/fragment.py``.  The bulk ingress and egress doors and the device
build lane wait for a later slice (ROADMAP Queue 1.5).
"""
