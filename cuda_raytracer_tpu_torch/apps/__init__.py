"""Applications: headless CLI renderer, interactive preview, animation."""
