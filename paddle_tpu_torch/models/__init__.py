"""Model programs built through the port's fluid layers."""
