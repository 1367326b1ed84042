"""Program IR, dtype tables and the variable scope."""
