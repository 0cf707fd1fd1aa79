"""The harness: the command line, discovery by name, the launch of one
process a chip, the closed loop, and the reduction of the device trace."""
