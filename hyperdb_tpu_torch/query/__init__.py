"""Query engine and filters."""
