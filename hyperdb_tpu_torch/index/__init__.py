"""Candidate indexes (the exact flat scan in this slice)."""
