"""The whole step's share of the card's peak in the tiled scenes (``portbench.readers.mfu``)."""
from portbench.readers import mfu as read  # noqa: F401
