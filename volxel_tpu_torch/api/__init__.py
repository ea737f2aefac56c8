"""Renderer facade, settings JSON and JAX-state import."""
