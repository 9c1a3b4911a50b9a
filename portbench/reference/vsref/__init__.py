"""A frozen copy of the port's host graph stages, the reference that the
benchmark holds the program's graph outputs to.

`core/` and `algos/` are copied from `vstrains_tpu_torch/core/` and
`vstrains_tpu_torch/algos/` at commit
bc5e135ef114cb1be5519b7422aa36d058e4b564, with the import prefix
rewritten and, in the text, paths into VStrains written as "VStrains'
<file>". These modules are themselves the port's copies of the JAX
package's host modules, which its tests pin to VStrains
(https://github.com/metagentools/VStrains). `graph_ops.py` keeps the two
functions of `vstrains_tpu_torch/ops/graph_ops.py` that the stages call.

The copy is not edited when the program is: it is the yardstick that a
later change to the program's host stages is held to. It imports nothing
of the program.
"""
