"""NumPy oracles of both recurrences, for the opt-in self-check."""
