"""System drivers: one module per way of driving the program, named by a
configuration file's `driver` key."""
