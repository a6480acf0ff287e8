"""Frozen operation and byte counts of the kernels' work, and the card's
peaks, for the rooflines and the step's share of the peak.  Counted from
the inputs the benchmark made, never from the program's functions."""
