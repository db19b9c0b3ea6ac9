"""One driver per kind of traffic mix (``traffic/<mix>.json``'s
``kind``): it builds the port's system under test, warms it up, runs
the measured window and the check, and returns the run's facts for the
metric readers."""
