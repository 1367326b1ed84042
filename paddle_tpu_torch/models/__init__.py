"""Model programs built directly as ProgramDescs."""
