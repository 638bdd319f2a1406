"""The cascade model: parameter init, layers, blocks and CascadeModel."""
