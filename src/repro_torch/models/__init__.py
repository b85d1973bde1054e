"""The language model the serving path runs (`transformer`) and its
building blocks (`layers`)."""
