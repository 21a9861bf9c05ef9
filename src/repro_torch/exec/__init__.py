"""Event traces (``trace.EventTrace``): request arrivals for serving."""
