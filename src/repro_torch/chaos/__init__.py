"""Chaos hook plane: off unless an injector is installed."""
