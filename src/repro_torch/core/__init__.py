"""Numerics core of the port: compensated-summation primitives."""
