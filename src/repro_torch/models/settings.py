"""Global model-lowering knobs: the accounting mode of the dry-run.

The reference's ``UNROLL_SCANS`` unrolls its ``lax.scan``s so XLA's cost
analysis sees every executed op; the port has no scan (its layer stacks
and attention chunks are Python loops, every op dispatched), so the
reference's ``scan_unroll()`` has nothing to set here and the flag keeps
the one meaning it can have: accounting mode. Set by
``launch/accounting.py`` around its reduced-depth traces, never for real
runs. In it ``chunked_attention`` takes coarse blocks: the same FLOPs and
far fewer Python iterations when a 32k prefill is traced.
"""
UNROLL_SCANS = False
# accounting-mode attention chunking (the reference's sizes; block size
# does not change FLOPs, only op count)
ACCT_Q_CHUNK = 2048
ACCT_KV_CHUNK = 4096
