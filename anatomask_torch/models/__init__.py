"""Shared network layers."""
