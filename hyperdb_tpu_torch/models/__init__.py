"""Embedding engines: the WordPiece tokenizer, the MiniLM-style encoder as
torch modules, and the hash and hybrid embedders."""
