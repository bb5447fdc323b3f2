"""Mixed-precision policies (the training pieces come with slice A)."""
