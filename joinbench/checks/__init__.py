"""Checks of the comparison that decides ``correct``, run on the card by
hand (never by the benchmark's own runs)."""
