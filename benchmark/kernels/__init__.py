"""The operations and bytes of each hand-written kernel on the timed path,
one file per kernel, computed from the configuration and the chunk."""
