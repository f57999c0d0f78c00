"""Corpus storage and the DB facade."""
