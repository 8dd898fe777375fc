"""Cross-pod communication of the port: the outer-sync delta codecs and
their wire format, the spec rules of every architecture on the
production meshes, and the activation hints that place DTensors."""
