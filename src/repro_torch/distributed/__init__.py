"""Cross-pod communication of the port: the outer-sync delta codecs.  The
collectives over a pod group of cards wait for ROADMAP A3b."""
