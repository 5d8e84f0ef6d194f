"""Operation and byte counts taken from shapes: the algorithm's, whatever
implements it. An operation is a multiply or an add (a multiply-add is 2),
or one elementwise function; each input byte is read once and each output
byte written once."""
