"""The whole step's share of the card's peak in the RCAN stream cell
(``portbench.readers.mfu``; the count is ``portbench.zoo.cascade_forward``)."""
from portbench.readers import mfu as read  # noqa: F401
