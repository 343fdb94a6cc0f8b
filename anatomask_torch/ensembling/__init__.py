"""Averaging of saved probabilities across configurations or folds."""
