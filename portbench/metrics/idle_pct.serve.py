"""The card's idle share in the stream cell (``portbench.readers.idle_pct``)."""
from portbench.readers import idle_pct as read  # noqa: F401
