"""Archives in the reference's .npz format."""
