"""Developer tooling that ships with the runtime (static analysis).
Ported from ``ray_tpu/devtools``. Nothing here is imported by production
code paths; a tier-1 test runs the checkers over the port's tree, so every
change is gated without external CI."""
