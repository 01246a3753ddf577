"""DDIM loops and x-space guidance."""
