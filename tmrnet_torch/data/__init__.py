"""Host-to-card input conventions."""
