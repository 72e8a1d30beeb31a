"""Function-word lists for German / French / Spanish.

The reference wires one list per language into BOTH StopwordType and
FrequentwordType (reference index.rs:2679-2695: the FREQUENT_* asset
feeds stopword filtering and n-gram frequent-word selection alike).
These sets are authored from the languages' closed word classes —
articles, prepositions, pronouns, conjunctions, auxiliaries — the same
population any frequent-word list over a large corpus converges to.
English lives in tokenizer.ENGLISH_STOPWORDS / ngram.ENGLISH_FREQUENT_WORDS.
"""

from __future__ import annotations

GERMAN_FUNCTION_WORDS = frozenset("""
aber alle allem allen aller alles als also am an andere anderem anderen
anderer anderes auch auf aus bei beim bin bis bist da damit dann das dass
daß dein deine dem den denn der deren des dessen dich die dies diese
diesem diesen dieser dieses dir doch dort du durch ein eine einem einen
einer eines er es etwas euch euer eure für gegen gewesen hab habe haben
hat hatte hatten hier hin hinter ich ihm ihn ihnen ihr ihre im in ist ja
jede jedem jeden jeder jedes jetzt kann kein keine keinem keinen keiner
können könnte machen man mehr mein meine mich mir mit muss musste nach
nicht nichts noch nun nur ob oder ohne sehr sein seine seinem seinen
seiner sich sie sind so sollte über um und uns unser unter vom von vor
war waren warst was weil weiter wenn wer werde werden wie wieder will
wir wird wirst wo wurde wurden zu zum zur zwar zwischen
""".split())

FRENCH_FUNCTION_WORDS = frozenset("""
a à afin ai ainsi après au aucun aussi autre aux avant avec avoir car ce
cela ces cet cette ceux chaque ci comme comment dans de dedans dehors
depuis des deux devant doit donc dont du elle elles en encore entre est
et étaient était été être eu fait faites fois font hors ici il ils je la
le les leur leurs lui ma mais me même mes mon ne ni nos notre nous on
ont ou où par parce pas peu peut plus pour pourquoi quand que quel
quelle quelles quels qui sa sans se ses seulement si sien son sont sous
soyez sur ta tandis te tes ton tous tout toute toutes très tu un une vos
votre vous vu ça étant
""".split())

SPANISH_FUNCTION_WORDS = frozenset("""
a al algo algunas algunos ante antes como con contra cual cuando de del
desde donde durante e el él ella ellas ellos en entre era erais eran
eras eres es esa esas ese eso esos esta estaba estado estamos están
estar este esto estos fue fueron fui ha habéis había han has hasta hay
la las le les lo los más me mi mis mucho muchos muy nada ni no nos
nosotros nuestra nuestro o os otra otras otro otros para pero poco por
porque que qué quien quienes se sea ser si sí sido sin sobre sois somos
son soy su sus también tanto te tenéis tenemos tener tengo ti tiene
tienen todo todos tu tus un una unas uno unos vosotros vuestra vuestro y
ya yo
""".split())
