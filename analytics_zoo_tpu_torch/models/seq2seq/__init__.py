from .seq2seq import RNNDecoder, RNNEncoder, Seq2Seq, Seq2SeqNet

__all__ = ["RNNDecoder", "RNNEncoder", "Seq2Seq", "Seq2SeqNet"]
