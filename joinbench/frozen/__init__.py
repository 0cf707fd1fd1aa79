"""Frozen copies of what the yardstick depends on, taken from the port at
commit 5f4d2a6. None of them imports the port."""
