"""The card's idle share in the tiled scenes (``portbench.readers.idle_pct``)."""
from portbench.readers import idle_pct as read  # noqa: F401
