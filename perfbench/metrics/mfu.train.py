"""The whole round's share of the cards' peak at the configuration's
precision (%): the round's necessary FLOPs (``roofline.counts``, no
recomputation) over the unprofiled rounds' host time a round times the
peak of every card the round uses. The round time holds the data wait,
as the round metric does."""
from harness.readers import mfu as read  # noqa: F401
