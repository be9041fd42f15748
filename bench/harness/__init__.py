"""The benchmark's frozen yardstick: seeded weights, traffic, the drive
loop, the FLOP and byte counts, the trace reduction and the comparison
that decides ``correct``."""
