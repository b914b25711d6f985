"""Helpers shared by the operators (a JAX-free copy of what they need)."""
