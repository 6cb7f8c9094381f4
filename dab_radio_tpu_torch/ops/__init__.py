"""Tensor ops of the receive chain: PLL mixing, OFDM sync, frame
demodulation, time deinterleaving and the punctured Viterbi decode, and
the numpy host helpers beside them (CRC, scrambler, Reed-Solomon, QMF)."""
