"""Step builders of the LM stack; so far the serving half (``steps``)."""
