"""Model definitions: the CNN families and the decoder-only LM."""
