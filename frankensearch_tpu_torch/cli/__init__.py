"""CLI product surface (the reference's ``fsfs`` binary analog)."""
