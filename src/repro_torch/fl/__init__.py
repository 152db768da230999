"""The round engine and the DisPFL strategies."""
