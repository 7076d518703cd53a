"""Entry points of the LM substrate: step functions and the serving loop."""
