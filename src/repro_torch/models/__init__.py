"""CNN backbones with HWIO weights over NHWC activations."""
