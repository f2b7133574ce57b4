"""Plane B of the port: the paper's chiplet/NoI co-simulation (counterpart
of the reference's ``core/``).

Plain numpy, copied from the reference with only its imports changed, so
every result equals the reference's on the same inputs: traffic
(``traffic``), the NoI evaluation (``noi``), placement and space-filling
curves (``placement``, ``sfc``), the MOO search (``moo``, ``rf``), the
2.5D-HI simulator (``simulator``), the HAIMA and TransPIM baselines
(``baselines``), thermal, faults, the device-mesh mapping study
(``hetero``) and the bridge from a measured serving run of the port's
engine (``cosim.cosim_from_engine``).
"""
