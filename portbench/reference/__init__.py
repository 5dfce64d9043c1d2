"""The plain float32 references, one module per ``arch_type``."""
