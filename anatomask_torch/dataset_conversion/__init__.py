"""Writing the raw dataset layout."""
