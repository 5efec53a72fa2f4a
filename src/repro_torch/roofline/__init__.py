"""Hardware constants of the port's target card."""
