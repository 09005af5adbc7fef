"""Runtime concurrency checker (``lockcheck``).

Only the runtime half of the analysis package is ported: core, rowpool,
qcache and the executor build their locks through
``lockcheck.named_lock``.  The project linter stays with the reference
package.
"""
