"""Numerics policy, configuration and run logging."""
