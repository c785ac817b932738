"""Plugins that put the port's vision pipeline behind other hosts."""
