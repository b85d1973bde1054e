"""The models the port serves: the language model (`transformer`) and its
building blocks (`layers`), and the CTR recommenders (`recsys`)."""
