"""CLIP tokenizers (the port's own copy)."""
