"""Dataset fingerprint, experiment planning and dataset checks."""
