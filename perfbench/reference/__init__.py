"""Plain float32 references, one file per architecture family."""
