"""Distributed plane of the port. Only the host-paced parameter-server
tier (:mod:`.ps`) is ported; the mesh, collectives, ZeRO, the ring route
and fleet wait for ROADMAP A5, the PS runtime and RPC for A7.4."""
