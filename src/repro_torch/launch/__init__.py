"""Entry points: the training launcher and its step loop."""
