"""In-repo native (C++) host-side components of the port.

``tokenizer.cc`` (word, filter and WordPiece tokenizers, the exact top-k
merge) and ``server.cc`` (the epoll serving front end) are the port's own
copies of the JAX package's sources. They are compiled with the host C++
compiler into one shared library under ``build/hyperdb_tpu_torch/`` at
first use and bound with ``ctypes`` (``tokenizer.py``). A failed build
raises; the Python tokenizers are the path for non-ASCII text, not a
stand-in for a missing library.
"""
