"""Tensor primitives and the hand-written kernel of the port."""
