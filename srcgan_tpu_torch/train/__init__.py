"""Training-side modules of the port (so far only checkpoint reading)."""
