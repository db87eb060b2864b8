"""The plain reference: PyTorch alone, with no import of the port, of the
JAX package or of JAX. Models in ``models/<family>.py``, codecs in
``codecs/<name>.py``, precision modes in ``precision.py``."""
