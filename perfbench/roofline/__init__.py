"""The yardstick's arithmetic: necessary operations and bytes from a
configuration's shapes, and the card's peaks (``peaks.json``)."""
