"""Model configurations, dense decoder layers and the LM (serving path)."""
