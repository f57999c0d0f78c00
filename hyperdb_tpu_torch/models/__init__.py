"""Embedding engines and their training: the WordPiece tokenizer and
trainer, the MiniLM-style encoder as torch modules, the hash and hybrid
embedders, the local training data, the InfoNCE step and ``finetune``."""
