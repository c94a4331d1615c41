"""Frozen copies of the input generators, in numpy: the same seed gives
the same scene arrays, which the program and the reference each build
their own scenes from."""
