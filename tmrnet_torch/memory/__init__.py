"""Long-term Feature Bank on the card."""
