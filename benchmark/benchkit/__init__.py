"""The benchmark's own machinery: discovery by name, traffic, weights,
drivers, traces, operation counts and the comparison that decides
``correct``.  It imports the system under test only in ``system.py``."""
