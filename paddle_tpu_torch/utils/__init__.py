"""Process-wide flags of the port (utils/flags.py)."""
