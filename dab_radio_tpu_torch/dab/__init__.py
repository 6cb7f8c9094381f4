"""DAB channel decode on tensors: FIC and MSC (time deinterleave,
depuncture, Viterbi, descramble). The byte protocols above them are the JAX
package's numpy modules, imported as they are."""
