"""The native C++ benchmark driver (join_main.cpp) and its staging
(export_join.py)."""
