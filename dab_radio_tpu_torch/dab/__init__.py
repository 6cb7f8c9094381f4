"""DAB channel decode on tensors: FIC and MSC (time deinterleave,
depuncture, Viterbi, descramble), and the host byte protocols above them
(FIG, ensemble database, superframes, AAC/SBR/PS, MP2, PAD/MOT, packets):
numpy copies of their counterparts in ``dab_radio_tpu/dab``."""
